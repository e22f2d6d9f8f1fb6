"""Fused vertex path: the port's constants and plain twins (the CPU side
of lemo_tpu_torch.body_model.vertex_cuda) vs lemo_tpu's vertex_pallas
(interpret mode), on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import vertex_pallas as JV
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu_torch.body_model import vertex_cuda as TV

torch.set_num_threads(2)


def _const_inputs():
    md = synthetic_smplx_npz()
    V = md["v_template"].shape[0]
    shape_expr = np.concatenate([md["shapedirs"][:, :, :10],
                                 md["shapedirs"][:, :, 10:20]], axis=-1)
    return (shape_expr, np.asarray(md["posedirs"], np.float64),
            np.asarray(md["v_template"], np.float64),
            np.asarray(md["weights"], np.float32),
            np.asarray(md["J_regressor"], np.float64), V)


@pytest.fixture(scope="module")
def consts():
    *args, _ = _const_inputs()
    return JV.build_fused_consts(*args)


def test_build_fused_consts_bit_equal():
    *args, _ = _const_inputs()
    ref = JV.build_fused_consts(*args)
    out = TV.build_fused_consts(*args)
    assert ref.keys() == out.keys()
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape
        assert np.array_equal(out[k], ref[k]), k


def _operands(consts, B, seed):
    rng = np.random.RandomState(seed)
    D = consts["fused_dirs"].shape[2]
    Jp = consts["lbs_w_pad"].shape[1]
    Bp = 128
    catT = np.zeros((D, Bp), np.float32)
    catT[:, :B] = rng.randn(D, B) * 0.3
    catT[-1, :B] = 1.0
    A2 = np.zeros((12, Jp, Bp), np.float32)
    A2[:, :, :B] = rng.randn(12, Jp, B) * 0.5
    dout = rng.randn(3, consts["fused_dirs"].shape[1], Bp).astype(np.float32)
    return catT, A2, dout


@pytest.mark.parametrize("B", [1, 5])
def test_plain_forward_matches_pallas(consts, B):
    catT, A2, _ = _operands(consts, B, seed=B)
    ref = JV.fused_lbs_vertices_planes(
        jnp.asarray(catT), jnp.asarray(A2),
        jnp.asarray(consts["fused_dirs"]), jnp.asarray(consts["lbs_w_pad"]))
    out = TV.vertex_plain_fwd(
        torch.as_tensor(catT), torch.as_tensor(A2),
        torch.as_tensor(consts["fused_dirs"]),
        torch.as_tensor(consts["lbs_w_pad"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("B", [1, 5])
def test_plain_backward_matches_pallas_vjp(consts, B):
    catT, A2, dout = _operands(consts, B, seed=10 + B)
    dirs_j = jnp.asarray(consts["fused_dirs"])
    w_j = jnp.asarray(consts["lbs_w_pad"])
    _, vjp = jax.vjp(lambda c, a: JV._vertex_core(c, a, dirs_j, w_j),
                     jnp.asarray(catT), jnp.asarray(A2))
    dcat_ref, da2_ref = vjp(jnp.asarray(dout))
    dcat, da2 = TV.vertex_plain_bwd(
        torch.as_tensor(catT), torch.as_tensor(A2),
        torch.as_tensor(consts["fused_dirs"]),
        torch.as_tensor(consts["lbs_w_pad"]), torch.as_tensor(dout))
    assert _rel(dcat.numpy(), np.asarray(dcat_ref)) < 5e-5
    assert _rel(da2.numpy(), np.asarray(da2_ref)) < 5e-5


def test_function_backward_is_the_plain_twin(consts):
    """Autograd through fused_lbs_vertices_planes on the CPU equals the
    plain backward twin, and the model constants get no gradient."""
    catT, A2, dout = _operands(consts, 3, seed=20)
    c = torch.as_tensor(catT).requires_grad_(True)
    a = torch.as_tensor(A2).requires_grad_(True)
    dirs = torch.as_tensor(consts["fused_dirs"]).requires_grad_(True)
    w = torch.as_tensor(consts["lbs_w_pad"])
    out = TV.fused_lbs_vertices_planes(c, a, dirs, w)
    (out * torch.as_tensor(dout)).sum().backward()
    dcat, da2 = TV.vertex_plain_bwd(torch.as_tensor(catT),
                                    torch.as_tensor(A2), dirs.detach(), w,
                                    torch.as_tensor(dout))
    np.testing.assert_array_equal(c.grad.numpy(), dcat.numpy())
    np.testing.assert_array_equal(a.grad.numpy(), da2.numpy())
    assert dirs.grad is None


def test_plain_backward_matches_autograd_of_plain_forward(consts):
    catT, A2, dout = _operands(consts, 4, seed=30)
    dirs = torch.as_tensor(consts["fused_dirs"])
    w = torch.as_tensor(consts["lbs_w_pad"])
    c = torch.as_tensor(catT).requires_grad_(True)
    a = torch.as_tensor(A2).requires_grad_(True)
    (TV.vertex_plain_fwd(c, a, dirs, w) * torch.as_tensor(dout)).sum(
    ).backward()
    dcat, da2 = TV.vertex_plain_bwd(torch.as_tensor(catT),
                                    torch.as_tensor(A2), dirs, w,
                                    torch.as_tensor(dout))
    assert _rel(dcat.numpy(), c.grad.numpy()) < 1e-5
    assert _rel(da2.numpy(), a.grad.numpy()) < 1e-5


def test_kernel_wrappers_refuse_cpu_tensors(consts):
    catT, A2, _ = _operands(consts, 2, seed=40)
    with pytest.raises(ValueError, match="CUDA"):
        TV.vertex_fwd_kernel(torch.as_tensor(catT), torch.as_tensor(A2),
                             torch.as_tensor(consts["fused_dirs"]),
                             torch.as_tensor(consts["lbs_w_pad"]))


def _plain_bwd_one_pass(catT, A2, dirs, w, dout):
    """The backward's plain twin as one function, as it stood before it
    was split into stages: the composition must keep its bits."""
    vs = torch.matmul(dirs, catT)
    T = torch.einsum("vj,kjb->kvb", w, A2)
    dT = torch.stack([dout[k // 3] * vs[k % 3] for k in range(9)]
                     + [dout[m] for m in range(3)])
    da2 = torch.einsum("vj,kvb->kjb", w, dT)
    dvs = torch.stack([T[n] * dout[0] + T[3 + n] * dout[1]
                       + T[6 + n] * dout[2] for n in range(3)])
    dcat = torch.einsum("nvd,nvb->db", dirs, dvs)
    return dcat, da2


def _torch_operands(consts, B, seed):
    catT, A2, dout = _operands(consts, B, seed)
    return (torch.as_tensor(catT), torch.as_tensor(A2),
            torch.as_tensor(consts["fused_dirs"]),
            torch.as_tensor(consts["lbs_w_pad"]), torch.as_tensor(dout))


@pytest.mark.parametrize("B", [1, 5])
def test_plain_backward_is_its_stages_bit_for_bit(consts, B):
    ops = _torch_operands(consts, B, seed=50 + B)
    dcat, da2 = TV.vertex_plain_bwd(*ops)
    ref_dcat, ref_da2 = _plain_bwd_one_pass(*ops)
    np.testing.assert_array_equal(dcat.numpy(), ref_dcat.numpy())
    np.testing.assert_array_equal(da2.numpy(), ref_da2.numpy())


@pytest.mark.parametrize("stage", ["pointwise", "dcat", "da2"])
@pytest.mark.parametrize("B", [1, 5])
def test_plain_backward_stage_matches_pallas_vjp(consts, stage, B):
    """Each stage of the plain backward against lemo_tpu's Pallas VJP
    (interpret mode). The reductions take the plain pointwise stage's vs
    and dvs; the pointwise stage is held through both reductions taken
    exactly (f64) on its outputs."""
    catT, A2, dirs, w, dout = _torch_operands(consts, B, seed=60 + B)
    dirs_j, w_j = jnp.asarray(dirs.numpy()), jnp.asarray(w.numpy())
    _, vjp = jax.vjp(lambda c, a: JV._vertex_core(c, a, dirs_j, w_j),
                     jnp.asarray(catT.numpy()), jnp.asarray(A2.numpy()))
    dcat_ref, da2_ref = (np.asarray(x) for x in vjp(jnp.asarray(
        dout.numpy())))
    vs, dvs = TV.vertex_plain_bwd_pointwise(catT, A2, dirs, w, dout)
    if stage == "pointwise":
        d64 = dirs.double()
        dcat = TV.dcat_plain_from_dvs(d64, dvs.double())
        da2 = TV.da2_plain_from_vs(w.double(), vs.double(), dout.double())
        assert _rel(dcat.numpy(), dcat_ref) < 5e-5
        assert _rel(da2.numpy(), da2_ref) < 5e-5
    elif stage == "dcat":
        assert _rel(TV.dcat_plain_from_dvs(dirs, dvs).numpy(),
                    dcat_ref) < 5e-5
    else:
        assert _rel(TV.da2_plain_from_vs(w, vs, dout).numpy(),
                    da2_ref) < 5e-5


_BWD_WRAPPERS = {
    "vertex_bwd_kernel": lambda c, a, d, w, g: TV.vertex_bwd_kernel(
        c, a, d, w, g),
    "vertex_bwd_pointwise_kernel": lambda c, a, d, w, g:
        TV.vertex_bwd_pointwise_kernel(c, a, d, w, g),
    "dcat_kernel_from_dvs": lambda c, a, d, w, g:
        TV.dcat_kernel_from_dvs(d, g),
    "da2_kernel_from_vs": lambda c, a, d, w, g:
        TV.da2_kernel_from_vs(w, g, g),
}


@pytest.mark.parametrize("name", list(_BWD_WRAPPERS))
def test_backward_wrappers_refuse_cpu_tensors(consts, name):
    counts = dict(TV.launches), dict(TV.stage_launches)
    with pytest.raises(ValueError, match="CUDA"):
        _BWD_WRAPPERS[name](*_torch_operands(consts, 2, seed=70))
    assert (TV.launches, TV.stage_launches) == counts


def test_backward_scratch_views(monkeypatch):
    """The backward's scratch: one buffer cut into vs, dvs and the two
    partial slabs at the extents the kernel reports, disjoint, each on a
    16-byte boundary (the kernels read and write float4)."""
    monkeypatch.setattr(TV, "bwd_slices", lambda D, Jp, Vp, Bp: (5, 3))
    D, Jp, Vp, Bp = 21, 56, 256, 32
    views = TV._bwd_scratch(D, Jp, Vp, Bp, "cpu")
    assert [tuple(v.shape) for v in views] == [
        (3, Vp, Bp), (3, Vp, Bp), (5, D, Bp), (3, 12, Jp, Bp)]
    spans = sorted((v.data_ptr(), v.data_ptr() + 4 * v.numel())
                   for v in views)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(v.is_contiguous() and v.data_ptr() % 16 == 0 for v in views)


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card(consts):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ops = [t.cuda() for t in _torch_operands(consts, 5, seed=80)]
    got = TV.vertex_bwd_kernel(*ops)
    again = TV.vertex_bwd_kernel(*ops)
    ref = TV.vertex_plain_bwd(*ops)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a)
        assert _rel(g.cpu().numpy(), r.cpu().numpy()) < 5e-5


# ---- the forward's stages and the backward from the forward's blend ------

def _plain_fwd_one_pass(catT, A2, dirs, w):
    """The forward's plain twin as one function, as it stood before it was
    split into the blend and the apply: the composition must keep its
    bits."""
    vs = torch.matmul(dirs, catT)
    T = torch.einsum("vj,kjb->kvb", w, A2)
    return torch.stack([
        T[9 + m] + T[3 * m] * vs[0] + T[3 * m + 1] * vs[1]
        + T[3 * m + 2] * vs[2] for m in range(3)])


@pytest.mark.parametrize("B", [1, 5])
def test_plain_forward_is_its_stages_bit_for_bit(consts, B):
    catT, A2, dirs, w, _ = _torch_operands(consts, B, seed=90 + B)
    vs = torch.empty(3, dirs.shape[1], catT.shape[1])
    out = TV.vertex_plain_fwd(catT, A2, dirs, w, vs)
    np.testing.assert_array_equal(
        out.numpy(), _plain_fwd_one_pass(catT, A2, dirs, w).numpy())
    np.testing.assert_array_equal(
        vs.numpy(), TV.vertex_plain_blend(catT, dirs).numpy())
    np.testing.assert_array_equal(
        out.numpy(), TV.vertex_plain_fwd(catT, A2, dirs, w).numpy())


@pytest.mark.parametrize("stage", ["blend", "apply"])
@pytest.mark.parametrize("B", [1, 5])
def test_plain_forward_stage_matches_pallas(consts, stage, B):
    """Each stage of the plain forward against lemo_tpu's `_vertex_core`
    forward (interpret mode) at the forward's 1e-5 m: the apply on the
    plain blend's vs; the blend through the apply taken exactly (f64)."""
    catT, A2, dirs, w, _ = _torch_operands(consts, B, seed=100 + B)
    ref = np.asarray(JV._vertex_core(
        jnp.asarray(catT.numpy()), jnp.asarray(A2.numpy()),
        jnp.asarray(dirs.numpy()), jnp.asarray(w.numpy())))
    vs = TV.vertex_plain_blend(catT, dirs)
    if stage == "blend":
        out = TV.vertex_plain_fwd_apply(vs.double(), A2.double(), w.double())
    else:
        out = TV.vertex_plain_fwd_apply(vs, A2, w)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B", [1, 5])
def test_plain_backward_from_kept_blend_bit_for_bit(consts, B):
    """The backward from the forward's blend is the backward that forms it
    again, to the bit."""
    catT, A2, dirs, w, dout = _torch_operands(consts, B, seed=110 + B)
    vs = torch.empty(3, dirs.shape[1], catT.shape[1])
    TV.vertex_plain_fwd(catT, A2, dirs, w, vs)
    for got, ref in zip(TV.vertex_plain_bwd(catT, A2, dirs, w, dout, vs),
                        TV.vertex_plain_bwd(catT, A2, dirs, w, dout)):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_function_backward_takes_the_forward_blend(consts, monkeypatch):
    """`_VertexCore` hands its forward's blend to the backward, which then
    need not form it again."""
    catT, A2, dirs, w, dout = _torch_operands(consts, 3, seed=120)
    seen = {}
    real = TV.vertex_plain_bwd

    def spy(c, a, d, ww, g, vs=None):
        seen["vs"] = vs
        return real(c, a, d, ww, g, vs)

    monkeypatch.setattr(TV, "vertex_plain_bwd", spy)
    c = catT.clone().requires_grad_(True)
    out = TV.fused_lbs_vertices_planes(c, A2, dirs, w)
    (out * dout).sum().backward()
    assert seen["vs"] is not None
    np.testing.assert_array_equal(seen["vs"].numpy(),
                                  TV.vertex_plain_blend(catT, dirs).numpy())


@pytest.mark.parametrize("B", [1, 5])
def test_function_gradients_match_pallas_vjp(consts, B):
    """Autograd through `_VertexCore` (the backward from the kept blend)
    against `jax.vjp` of lemo_tpu's `_vertex_core` (interpret mode)."""
    catT, A2, dirs, w, dout = _torch_operands(consts, B, seed=130 + B)
    dirs_j, w_j = jnp.asarray(dirs.numpy()), jnp.asarray(w.numpy())
    _, vjp = jax.vjp(lambda cc, aa: JV._vertex_core(cc, aa, dirs_j, w_j),
                     jnp.asarray(catT.numpy()), jnp.asarray(A2.numpy()))
    dcat_ref, da2_ref = (np.asarray(x) for x in vjp(jnp.asarray(
        dout.numpy())))
    c = catT.clone().requires_grad_(True)
    a = A2.clone().requires_grad_(True)
    (TV.fused_lbs_vertices_planes(c, a, dirs, w) * dout).sum().backward()
    assert _rel(c.grad.numpy(), dcat_ref) < 5e-5
    assert _rel(a.grad.numpy(), da2_ref) < 5e-5


_FWD_WRAPPERS = {
    "vertex_fwd_kernel": lambda c, a, d, w, g: TV.vertex_fwd_kernel(
        c, a, d, w),
    "vertex_fwd_kernel_keeping_blend": lambda c, a, d, w, g:
        TV.vertex_fwd_kernel(c, a, d, w, torch.empty_like(g)),
    "vertex_blend_kernel": lambda c, a, d, w, g: TV.vertex_blend_kernel(c, d),
    "vertex_fwd_apply_kernel": lambda c, a, d, w, g:
        TV.vertex_fwd_apply_kernel(g, a, w),
    "vertex_bwd_kernel_from_blend": lambda c, a, d, w, g:
        TV.vertex_bwd_kernel(c, a, d, w, g, torch.empty_like(g)),
}


@pytest.mark.parametrize("name", list(_FWD_WRAPPERS))
def test_forward_wrappers_refuse_cpu_tensors(consts, name):
    counts = dict(TV.launches), dict(TV.stage_launches)
    with pytest.raises(ValueError, match="CUDA"):
        _FWD_WRAPPERS[name](*_torch_operands(consts, 2, seed=140))
    assert (TV.launches, TV.stage_launches) == counts


def test_backward_scratch_views_with_kept_blend(monkeypatch):
    """Given the forward's blend, the backward's scratch holds no blend of
    its own: the given tensor comes back first, then dvs and the two
    partial slabs."""
    monkeypatch.setattr(TV, "bwd_slices", lambda D, Jp, Vp, Bp: (5, 3))
    D, Jp, Vp, Bp = 21, 56, 256, 32
    vs = torch.empty(3, Vp, Bp)
    views = TV._bwd_scratch(D, Jp, Vp, Bp, "cpu", vs)
    assert views[0] is vs
    assert [tuple(v.shape) for v in views[1:]] == [
        (3, Vp, Bp), (5, D, Bp), (3, 12, Jp, Bp)]
    assert sum(v.numel() for v in views[1:]) == \
        views[1].untyped_storage().nbytes() // 4


@pytest.mark.cuda
def test_forward_kernel_matches_plain_on_card(consts):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    catT, A2, dirs, w, dout = (t.cuda() for t in
                               _torch_operands(consts, 5, seed=150))
    vs = torch.empty_like(dout)
    got = TV.vertex_fwd_kernel(catT, A2, dirs, w, vs)
    assert torch.equal(got, TV.vertex_fwd_kernel(catT, A2, dirs, w))
    ref = TV.vertex_plain_fwd(catT, A2, dirs, w)
    assert float((got - ref).abs().max()) < 1e-5
    assert float((vs - TV.vertex_plain_blend(catT, dirs)).abs().max()) < 1e-5
    for g, r in zip(TV.vertex_bwd_kernel(catT, A2, dirs, w, dout, vs),
                    TV.vertex_bwd_kernel(catT, A2, dirs, w, dout)):
        assert torch.equal(g, r)
