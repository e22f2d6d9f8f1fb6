"""Body model: the port's make_forward_fn (the separate-matmul path and
the fused path through the plain twins) and VPoser decode vs lemo_tpu on
the 536-vertex synthetic model, with the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lemo_tpu.body_model.lbs as lbs_mod
from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.body_model import make_forward_fn as j_fwd
from lemo_tpu.body_model import vposer as j_vp
from lemo_tpu.testing.synthetic import synthetic_smplx_npz as j_synth
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.body_model import make_forward_fn as t_fwd
from lemo_tpu_torch.body_model import vposer as t_vp
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz as t_synth

torch.set_num_threads(2)

PATHS = ["separate", "fused"]


@pytest.fixture(scope="module")
def models():
    jm = j_load(j_synth(), use_pca=True, num_pca_comps=12, build_fused=True)
    tms = {p: t_load(t_synth(), use_pca=True, num_pca_comps=12,
                     build_fused=(p == "fused"), device="cpu")
           for p in PATHS}
    return jm, tms


def _run_jax(jm, params, impl):
    old = lbs_mod.LBS_IMPL
    lbs_mod.LBS_IMPL = impl
    try:
        return j_fwd(jm)({k: jnp.asarray(v) for k, v in params.items()},
                         jm.consts)
    finally:
        lbs_mod.LBS_IMPL = old


def _params(jm, B, seed):
    rng = np.random.RandomState(seed)
    p = {k: np.zeros(v.shape, np.float32)
         for k, v in jm.zero_params(B).items()}
    p["body_pose"] = (rng.randn(B, 63) * 0.4).astype(np.float32)
    p["global_orient"] = (rng.randn(B, 3) * 0.5).astype(np.float32)
    p["transl"] = rng.randn(B, 3).astype(np.float32)
    p["betas"] = (rng.randn(B, 10) * 0.5).astype(np.float32)
    p["expression"] = (rng.randn(B, 10) * 0.5).astype(np.float32)
    p["left_hand_pose"] = (rng.randn(B, 12) * 0.3).astype(np.float32)
    p["jaw_pose"] = (rng.randn(B, 3) * 0.2).astype(np.float32)
    return p


def test_model_constants_match(models):
    jm, tms = models
    for path, tm in tms.items():
        assert tm.config._asdict() == jm.config._asdict()
        np.testing.assert_array_equal(tm.parents, jm.parents)
        for k, v in tm.consts.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jm.consts[k]),
                                          err_msg=f"{path}:{k}")
        missing = set(jm.consts) - set(tm.consts)
        assert missing <= {"fused_dirs", "lbs_w_pad", "j_ext"}


def test_zero_params_match(models):
    jm, tms = models
    zt = tms["fused"].zero_params(3)
    zj = jm.zero_params(3)
    assert zt.keys() == zj.keys()
    for k in zj:
        assert tuple(zt[k].shape) == zj[k].shape


@pytest.fixture(scope="module")
def jax_refs(models):
    """JAX forwards, computed once per (B, implementation)."""
    jm, _ = models
    cache = {}

    def get(B, impl):
        if (B, impl) not in cache:
            cache[B, impl] = _run_jax(jm, _params(jm, B, seed=B), impl)
        return cache[B, impl]
    return get


@pytest.mark.parametrize("jax_impl", ["xla", "fused"])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("B", [1, 5])
def test_forward_matches(models, jax_refs, path, jax_impl, B):
    jm, tms = models
    p = _params(jm, B, seed=B)
    ref = jax_refs(B, jax_impl)
    tm = tms[path]
    out = t_fwd(tm)({k: torch.as_tensor(v) for k, v in p.items()},
                    tm.consts)
    for key in ("vertices", "joints", "full_pose"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-6, err_msg=key)


GRAD_NAMES = ["body_pose", "betas", "transl", "expression",
              "global_orient", "left_hand_pose"]


@pytest.fixture(scope="module")
def grad_case(models):
    """Inputs, target and JAX's gradients (XLA path), computed once."""
    jm, _ = models
    p = _params(jm, 3, seed=4)
    target = np.random.RandomState(9).randn(3, jm.num_verts, 3).astype(
        np.float32) * 0.1
    fwd = j_fwd(jm)

    def jloss(*args):
        q = {k: jnp.asarray(v) for k, v in p.items()}
        q.update(dict(zip(GRAD_NAMES, args)))
        out = fwd(q, jm.consts)
        return (jnp.abs(out["vertices"] - target).mean()
                + (out["joints"] ** 2).mean())

    old = lbs_mod.LBS_IMPL
    lbs_mod.LBS_IMPL = "xla"
    try:
        g_ref = jax.jit(jax.grad(jloss, argnums=tuple(
            range(len(GRAD_NAMES)))))(*[jnp.asarray(p[n])
                                        for n in GRAD_NAMES])
    finally:
        lbs_mod.LBS_IMPL = old
    return p, target, [np.asarray(g) for g in g_ref]


@pytest.mark.parametrize("path", PATHS)
def test_gradients_match(models, grad_case, path):
    _, tms = models
    p, target, g_ref = grad_case
    tm = tms[path]
    q = {k: torch.as_tensor(v).requires_grad_(k in GRAD_NAMES)
         for k, v in p.items()}
    out = t_fwd(tm)(q, tm.consts)
    ((out["vertices"] - torch.as_tensor(target)).abs().mean()
     + (out["joints"] ** 2).mean()).backward()
    for n, gr in zip(GRAD_NAMES, g_ref):
        rel = np.abs(q[n].grad.numpy() - gr).max() / max(
            np.abs(gr).max(), 1e-8)
        assert rel < 5e-5, (n, rel)


@pytest.fixture(scope="module")
def vposer_params():
    jp = j_vp.init_vposer(jax.random.PRNGKey(0))
    return jp, from_numpy_tree({k: np.asarray(v) for k, v in jp.items()},
                               "cpu")


@pytest.mark.parametrize("output_type", ["aa", "matrot"])
def test_vposer_decode_matches(vposer_params, output_type):
    jp, tp = vposer_params
    z = (np.random.RandomState(3).randn(7, 32) * 0.8).astype(np.float32)
    ref = np.asarray(j_vp.decode(jp, jnp.asarray(z), output_type))
    out = t_vp.decode(tp, torch.as_tensor(z), output_type).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_vposer_init_layout_matches(vposer_params):
    jp, _ = vposer_params
    tp = t_vp.init_vposer(torch.Generator().manual_seed(0))
    assert tp.keys() == jp.keys()
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k


@pytest.mark.parametrize("num_joints,family", [
    (24, "smpl"), (52, "smplh"), (16, "mano")])
def test_other_families_match(num_joints, family):
    """The non-SMPL-X families the loader infers from the posedirs width:
    same config, parameter layout and forward as lemo_tpu."""
    md = j_synth(num_verts=200, num_joints=num_joints, seed=8)
    jm = j_load(md, flat_hand_mean=True)
    tm = t_load(t_synth(num_verts=200, num_joints=num_joints, seed=8),
                flat_hand_mean=True, device="cpu")
    assert tm.config._asdict() == jm.config._asdict()
    assert tm.config.model_type == family
    rng = np.random.RandomState(num_joints)
    p = {k: (rng.randn(*v.shape) * 0.2).astype(np.float32)
         for k, v in jm.zero_params(3).items()}
    assert {k: v.shape for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in tm.zero_params(3).items()}
    ref = _run_jax(jm, p, "xla")
    out = t_fwd(tm)({k: torch.as_tensor(v) for k, v in p.items()}, tm.consts)
    for key in ("vertices", "joints", "full_pose"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-6, err_msg=key)


def test_load_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_load(t_synth(), use_pca=True, num_pca_comps=12)


def test_fused_path_without_posedirs_matches():
    """use_posedirs=False through the fused path (a zero pose block in the
    kernels' dirs) against lemo_tpu's XLA path without pose blend shapes."""
    jm = j_load(j_synth(), use_pca=True, num_pca_comps=12,
                use_posedirs=False)
    tm = t_load(t_synth(), use_pca=True, num_pca_comps=12,
                use_posedirs=False, build_fused=True, device="cpu")
    assert "fused_dirs" in tm.consts and "posedirs" not in tm.consts
    p = _params(jm, 4, seed=21)
    ref = _run_jax(jm, p, "xla")
    out = t_fwd(tm)({k: torch.as_tensor(v) for k, v in p.items()}, tm.consts)
    for key in ("vertices", "joints"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-6, err_msg=key)


def test_load_model_on_card_refuses_unfused(monkeypatch):
    """On the card the body model has no route around the fused kernels:
    asking for the separate-matmul path there raises."""
    import lemo_tpu_torch.body_model.smplx as TS

    monkeypatch.setattr(TS, "resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="build_fused"):
        t_load(t_synth(), use_pca=True, num_pca_comps=12,
               build_fused=False, device="cuda")


def test_separate_lbs_refuses_tensors_off_the_cpu():
    """The separate-matmul lbs serves the CPU only; a tensor anywhere else
    (here on the meta device) raises instead of running plain ops."""
    from lemo_tpu_torch.body_model import lbs as TLbs

    tm = t_load(t_synth(), device="cpu")
    c = {k: v.to("meta") for k, v in tm.consts.items()}
    J = tm.num_joints
    with pytest.raises(ValueError, match="fused"):
        TLbs.lbs(torch.zeros(2, 20, device="meta"),
                 torch.zeros(2, 3 * J, device="meta"), c["v_template"],
                 c["shapedirs_flat"], c["posedirs"], c["J_regressor"],
                 tm.parents, c["lbs_weights"])
