"""AMASS Stage 2 in the port vs lemo_tpu: the loss terms, the Adam
engine, the whole temporal fitter on the 400-vertex setup, the data
helpers, and the port's import and device rules."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.body_model import vposer as j_vp
from lemo_tpu.data import markers as j_markers
from lemo_tpu.data import repr as j_repr
from lemo_tpu.data import segments as j_segments
from lemo_tpu.data.stats import GlobalStats as JStats
from lemo_tpu.fitting import adam as j_adam
from lemo_tpu.fitting import amass_temp as j_s2
from lemo_tpu.priors.conv_ae import init_smooth_enc
from lemo_tpu.testing.synthetic import synthetic_smplx_npz as j_synth
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.data import markers as t_markers
from lemo_tpu_torch.data import repr as t_repr
from lemo_tpu_torch.data import segments as t_segments
from lemo_tpu_torch.fitting import adam as t_adam
from lemo_tpu_torch.fitting import amass_temp as t_s2
from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz as t_synth

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def priors():
    """JAX-initialized VPoser/encoder params and stats, carried across."""
    vpp = {k: np.asarray(v) for k, v in
           j_vp.init_vposer(jax.random.PRNGKey(0)).items()}
    enc = {k: np.asarray(v) for k, v in
           init_smooth_enc(jax.random.PRNGKey(1)).items()}
    rng = np.random.RandomState(2)
    # a small std puts the normalized velocities at O(1-10), so the
    # encoder's data-dependent response dominates its bias terms
    stats = JStats(Xmean=rng.randn(1, 1, 243) * 0.1,
                   Xstd=np.ones(243) * 0.01)
    return (vpp, enc, stats), (from_numpy_tree(vpp, "cpu"),
                               from_numpy_tree(enc, "cpu"),
                               from_numpy_tree(stats, "cpu"))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def test_smoothness_prior_loss_matches(priors):
    (_, enc_j, stats_j), (_, enc_t, stats_t) = priors
    rng = np.random.RandomState(4)
    T = 20
    markers = (rng.randn(1, 81, 3) * 0.3
               + np.linspace(0, 1, T)[:, None, None] * [0.5, 0.1, 0]
               + rng.randn(T, 81, 3) * 0.05).astype(np.float32)
    joints0 = (np.array([[0, 0, 0.9], [0.1, 0, 0.9], [-0.1, 0.02, 0.9]]
                        + [[0, 0, 1]] * 22)
               + rng.randn(25, 3) * 0.01).astype(np.float32)
    ref = j_s2.smoothness_prior_loss(enc_j, jnp.asarray(markers),
                                     jnp.asarray(joints0), stats_j)
    out = t_s2.smoothness_prior_loss(enc_t, torch.as_tensor(markers),
                                     torch.as_tensor(joints0), stats_t)
    assert _rel(out, ref) < 1e-5


@pytest.mark.parametrize("moving", [False, True])
def test_contact_friction_loss_matches(moving):
    V, T = 400, 12
    feet = j_segments.foot_vertex_ids(num_verts=V)
    rng = np.random.RandomState(5)
    verts = np.ones((T, V, 3), np.float32)
    if moving:
        verts += np.cumsum(rng.randn(T, V, 3) * 0.01, axis=0).astype(
            np.float32)
    lbl = (rng.rand(T, 4) > 0.3).astype(np.float32)
    ref = j_s2.contact_friction_loss(jnp.asarray(verts), jnp.asarray(lbl),
                                     feet)
    out = t_s2.contact_friction_loss(torch.as_tensor(verts),
                                     torch.as_tensor(lbl),
                                     t_s2.foot_selection(feet, "cpu"))
    if moving:
        assert float(ref) > 0.0
        assert _rel(out, ref) < 1e-5
    else:
        assert float(out) == float(ref) == 0.0


def _quadratic(rng):
    """A diagonal quadratic whose optimum stays farther from the start
    than 20 steps can travel, so every gradient is far from zero and the
    comparison tests Adam's update, not f32 noise near the optimum."""
    a = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    start = b / a + np.where(rng.rand(12) > 0.5, 1.0, -1.0) * (
        2.0 + rng.rand(12))
    x0 = {"x": start[:6].astype(np.float32),
          "y": start[6:].reshape(2, 3).astype(np.float32)}
    return a, b, x0


def test_run_adam_matches_optax():
    A, b, x0 = _quadratic(np.random.RandomState(6))
    steps = 20
    lr = j_adam.piecewise_lr([(0, 0.05), (11, 0.02)], steps)

    def jloss(p):
        v = jnp.concatenate([p["x"], p["y"].reshape(-1)])
        return (0.5 * jnp.asarray(A) * v * v - jnp.asarray(b) * v).sum()

    jp, jl, _ = j_adam.run_adam(jloss, {k: jnp.asarray(v)
                                        for k, v in x0.items()}, steps, lr)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)

    def tloss(p):
        v = torch.cat([p["x"], p["y"].reshape(-1)])
        return (0.5 * At * v * v - bt * v).sum()

    tlr = t_adam.piecewise_lr([(0, 0.05), (11, 0.02)], steps)
    np.testing.assert_allclose(tlr, np.asarray(lr), rtol=1e-7)
    tp, tl = t_adam.run_adam(tloss, {k: torch.as_tensor(v)
                                     for k, v in x0.items()}, steps, tlr)
    for k in x0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6)
    # losses are O(10-40): f32 summation order alone moves them ~1e-7 rel
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    # and optax's own Adam, stepped by hand, agrees
    opt = optax.adam(0.05)
    p = {k: jnp.asarray(v) for k, v in x0.items()}
    st = opt.init(p)
    g = jax.grad(jloss)(p)
    upd, st = opt.update(g, st, p)
    p1 = optax.apply_updates(p, upd)
    tp1, _ = t_adam.run_adam(tloss, {k: torch.as_tensor(v)
                                     for k, v in x0.items()}, 1, [0.05])
    for k in x0:
        np.testing.assert_allclose(tp1[k].numpy(), np.asarray(p1[k]),
                                   atol=1e-6)


def test_run_adam_freezes_on_nan():
    A, b, x0 = _quadratic(np.random.RandomState(7))
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    calls = {"n": 0}

    def tloss(p):
        calls["n"] += 1
        v = torch.cat([p["x"], p["y"].reshape(-1)])
        loss = (0.5 * At * v * v - bt * v).sum()
        return loss * float("nan") if calls["n"] == 4 else loss

    tp3, _ = t_adam.run_adam(tloss, {k: torch.as_tensor(v)
                                     for k, v in x0.items()}, 3, [0.05] * 3)
    calls["n"] = 0
    tp, tl = t_adam.run_adam(tloss, {k: torch.as_tensor(v)
                                     for k, v in x0.items()}, 8, [0.05] * 8)
    assert np.isnan(tl[3].item()) and np.isfinite(tl[:3].numpy()).all()
    for k in x0:  # frozen at the params before the NaN step
        np.testing.assert_array_equal(tp[k].numpy(), tp3[k].numpy())


@pytest.fixture(scope="module")
def fit_setup(priors):
    (vpp_j, enc_j, _), (vpp_t, enc_t, _) = priors
    stats_j = JStats(Xmean=np.zeros((1, 1, 243)), Xstd=np.ones(243))
    stats_t = from_numpy_tree(stats_j, "cpu")
    md_j = j_synth(num_verts=400, seed=4)
    jm = j_load(md_j, use_pca=True, num_pca_comps=12)
    ids67 = j_markers.marker_indices(False, num_verts=400)
    ids81 = j_markers.marker_indices(True, num_verts=400)
    feet = j_segments.foot_vertex_ids(num_verts=400)
    rng = np.random.RandomState(3)
    T = 16
    target = (rng.randn(T, 67, 3) * 0.2).astype(np.float32)
    contact = (rng.rand(T, 4) > 0.5).astype(np.float32)
    init72 = (rng.randn(T, 72) * 0.1).astype(np.float32)
    x_ref, l_ref = j_s2.make_temporal_fitter(
        jm, vpp_j, enc_j, stats_j, ids67, ids81, feet, num_steps=5)(
        jnp.asarray(target), jnp.asarray(contact), jnp.asarray(init72))
    return ((vpp_t, enc_t, stats_t), (ids67, ids81, feet),
            (target, contact, init72), (np.asarray(x_ref), np.asarray(l_ref)))


@pytest.mark.parametrize("path", ["separate", "fused"])
def test_temporal_fitter_matches(fit_setup, path):
    (vpp, enc, stats), (ids67, ids81, feet), data, (x_ref, l_ref) = fit_setup
    tm = t_load(t_synth(num_verts=400, seed=4), use_pca=True,
                num_pca_comps=12, build_fused=(path == "fused"),
                device="cpu")
    fit = t_s2.make_temporal_fitter(tm, vpp, enc, stats, ids67, ids81, feet,
                                    num_steps=5, device="cpu")
    x72, losses = fit(*data)
    assert x72.shape == (16, 72) and losses.shape == (5,)
    np.testing.assert_allclose(losses.numpy(), l_ref, rtol=1e-3)
    np.testing.assert_allclose(x72.numpy(), x_ref, atol=2e-3)
    # betas stay frozen
    np.testing.assert_array_equal(x72[:, 6:16].numpy(), data[2][:, 6:16])


def test_temporal_fitter_without_device_needs_cuda(fit_setup):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None is valid here")
    (vpp, enc, stats), (ids67, ids81, feet), _, _ = fit_setup
    tm = t_load(t_synth(num_verts=400, seed=4), use_pca=True,
                num_pca_comps=12, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_s2.make_temporal_fitter(tm, vpp, enc, stats, ids67, ids81, feet)


@pytest.mark.parametrize("with_hand", [False, True])
@pytest.mark.parametrize("num_verts", [None, 400])
def test_marker_indices_match(with_hand, num_verts):
    np.testing.assert_array_equal(
        t_markers.marker_indices(with_hand, num_verts=num_verts),
        j_markers.marker_indices(with_hand, num_verts=num_verts))


@pytest.mark.parametrize("num_verts", [None, 400])
def test_foot_vertex_ids_match(num_verts):
    ref = j_segments.foot_vertex_ids(num_verts)
    out = t_segments.foot_vertex_ids(num_verts)
    assert ref.keys() == out.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])


def test_segments_asset_is_a_byte_copy():
    with open(os.path.join(REPO, "lemo_tpu", "assets",
                           "body_segments.npz"), "rb") as a, \
            open(os.path.join(REPO, "lemo_tpu_torch", "assets",
                              "body_segments.npz"), "rb") as b:
        assert a.read() == b.read()


def test_frame0_normalizer_matches():
    j0 = np.random.RandomState(8).randn(25, 3).astype(np.float32)
    R_ref, o_ref = j_repr.frame0_normalizer(jnp.asarray(j0))
    R, o = t_repr.frame0_normalizer(torch.as_tensor(j0))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_ref), atol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_model_is_bit_identical(seed):
    ref, out = j_synth(seed=seed), t_synth(seed=seed)
    assert ref.keys() == out.keys()
    for k in ref:
        assert np.array_equal(ref[k], out[k]), k


def test_port_imports_no_jax():
    """Importing the port and every submodule (the AMASS data layer,
    both stages, both AMASS CLIs, the optimizer family, the GMM prior,
    camera init and eval_prox among them) pulls in neither jax nor
    any lemo_tpu module, and needs neither cv2, PIL nor yaml (all three
    are made unimportable first); the slice of utilities, the BodyModel
    API, the native library, the JPEG decoder and its test encoder and
    the render/occlusion/visualization CLIs among them, and matplotlib
    not at all."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import pkgutil, importlib, lemo_tpu_torch\n"
        "for m in pkgutil.walk_packages(lemo_tpu_torch.__path__, "
        "'lemo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "need = ['lemo_tpu_torch.data.amass',"
        " 'lemo_tpu_torch.fitting.amass_perframe',"
        " 'lemo_tpu_torch.fitting.amass_temp',"
        " 'lemo_tpu_torch.cli.opt_amass_perframe',"
        " 'lemo_tpu_torch.cli.opt_amass_temp',"
        " 'lemo_tpu_torch.train.smooth', 'lemo_tpu_torch.train.infill',"
        " 'lemo_tpu_torch.train.vposer', 'lemo_tpu_torch.utils.logging',"
        " 'lemo_tpu_torch.utils.metrics',"
        " 'lemo_tpu_torch.cli.train_smooth_prior',"
        " 'lemo_tpu_torch.cli.train_infill_prior',"
        " 'lemo_tpu_torch.cli.test_smooth_prior',"
        " 'lemo_tpu_torch.cli.eval_amass', 'lemo_tpu_torch.fitting.lbfgs',"
        " 'lemo_tpu_torch.priors.body_priors',"
        " 'lemo_tpu_torch.fitting.prox.camera_init',"
        " 'lemo_tpu_torch.cli.eval_prox', 'lemo_tpu_torch.utils.tools',"
        " 'lemo_tpu_torch.utils.profiling', 'lemo_tpu_torch.utils.raster',"
        " 'lemo_tpu_torch.utils.viz', 'lemo_tpu_torch.utils.mesh_viewer',"
        " 'lemo_tpu_torch.utils.occlusion_mask',"
        " 'lemo_tpu_torch.body_model.body_model_api',"
        " 'lemo_tpu_torch.ops.native',"
        " 'lemo_tpu_torch.cli.get_occlusion_mask',"
        " 'lemo_tpu_torch.cli.render_fitting',"
        " 'lemo_tpu_torch.cli.vis_opt_amass',"
        " 'lemo_tpu_torch.data.jpeg', 'lemo_tpu_torch.testing.jpeg_encode']\n"
        "assert 'matplotlib' not in sys.modules\n"
        "assert all(m in sys.modules for m in need), need\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'optax' or m == 'lemo_tpu' or m.startswith('lemo_tpu.')]\n"
        "print(len(list(pkgutil.walk_packages(lemo_tpu_torch.__path__))))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 10
