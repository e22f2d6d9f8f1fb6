"""The port's PROX loss (`lemo_tpu_torch.fitting.prox.losses`) against
`lemo_tpu`'s on one window of a synthetic recording: every term of
`make_prox_loss` at rel 1e-5 and the parameter gradients at rel 1e-4 of
each gradient's scale, with the depth terms in their full form and in
their candidate form (frozen and live visibility); and the depth
candidate pre-pass (ids equal, frozen pairs at rel 1e-5)."""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.body_model import make_forward_fn as j_fwd
from lemo_tpu.body_model.vertex_ids import smpl_to_openpose
from lemo_tpu.config import ProxConfig as JConfig
from lemo_tpu.data.prox import ProxRecording as JRec
from lemo_tpu.data.prox import ProxWindowDataset as JDataset
from lemo_tpu.data.stats import GlobalStats as JGlobal
from lemo_tpu.data.stats import Local4ChanStats as JLocal
from lemo_tpu.fitting.prox import driver as j_driver
from lemo_tpu.fitting.prox import losses as j_losses
from lemo_tpu.fitting.prox.infill_prepass import run_infill_prepass as j_pre
from lemo_tpu.priors.conv_ae import init_smooth_enc
from lemo_tpu.testing.synthetic_prox import \
    write_synthetic_prox_recording as j_write
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.body_model import make_forward_fn as t_fwd
from lemo_tpu_torch.config.prox_config import ProxConfig as TConfig
from lemo_tpu_torch.convert import from_numpy_tree, prox_static_from_numpy
from lemo_tpu_torch.fitting.prox import driver as t_driver
from lemo_tpu_torch.fitting.prox import losses as t_losses

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "lemo_tpu", "assets")
T = 12


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def window():
    info = j_write(tempfile.mkdtemp(), num_frames=T, seed=1,
                   occlusion_frac=0.3)
    jm = j_load(info["model_dict"], use_pca=True, num_pca_comps=12)
    tm = t_load(info["model_dict"], use_pca=True, num_pca_comps=12,
                device="cpu")
    rng = np.random.RandomState(0)
    # a small std puts the normalized velocities at O(1-10), so the
    # smoothness encoder's data-dependent response dominates its biases
    # (with bias-dominated codes, dz/dt is a difference of near-equal
    # numbers and convolution summation order alone moves it ~1e-4)
    j_smooth = JGlobal(Xmean=rng.randn(1, 1, 243) * 0.1,
                       Xstd=np.ones(243) * 0.01)
    j_assets = j_driver.ProxAssets(
        model=jm, vposer_params=info["vposer_params"],
        smooth_enc_params=init_smooth_enc(jax.random.PRNGKey(0)),
        smooth_stats=j_smooth,
        infill_ae_params={k: jnp.asarray(v) for k, v in np.load(
            os.path.join(ASSETS, "infill_ae.npz")).items()},
        infill_stats=JLocal.load(os.path.join(ASSETS, "infill_stats.npz")))
    cfg_kw = dict(
        recording_dir=info["recording_dir"], batch_size=T, flip=False,
        s2m=True, m2s=True, contact=True, interpenetration=False,
        use_motion_infill_prior=True, sdf_fp8=True, sdf_candidates=48,
        depth_candidates=40, infill_finetune_steps=2,
        friction_normal_weights=[1.0], friction_tangent_weights=[1.0])
    j_cfg, t_cfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    rec = JRec.from_recording_dir(info["recording_dir"])
    j_assets = dataclasses.replace(j_assets,
                                   scene_verts=rec.load_scene_mesh())
    ds = JDataset(rec, output_params_dir=tempfile.mkdtemp(), batch_size=T,
                  flip=False)
    wd = ds.load_window(0)
    jw = ds.joint_weights()
    warm = {k: jnp.asarray(v) for k, v in wd["warm_start"].items()}
    mv, mj = j_driver._make_warm_world_markers(j_assets, rec)(warm)
    ir = j_pre(j_assets.infill_ae_params, mv, mj,
               jnp.asarray(wd["marker_mask"]), j_assets.infill_stats,
               finetune_steps=2)
    st_j = j_driver.build_window_static(j_cfg, j_assets, rec, wd, jw, ir)
    st_t = prox_static_from_numpy(st_j, "cpu", sdf_mode="fp8")
    t_assets = t_driver.ProxAssets(
        model=tm, vposer_params=from_numpy_tree(_np(info["vposer_params"]),
                                                "cpu"),
        smooth_enc_params=st_t.smooth_enc_params,
        smooth_stats=st_t.smooth_stats,
        scene_verts=np.asarray(j_assets.scene_verts))
    w_j = j_driver.weights_from_config(j_cfg)
    verts = j_driver._warm_start_vertices(j_cfg, j_assets, warm)
    zmin = float((np.asarray(verts)[..., 1] + 1.2).min())
    w_t = t_losses.ProxWeights(**dataclasses.asdict(w_j))
    return dict(info=info, jm=jm, tm=tm, j_assets=j_assets,
                t_assets=t_assets, j_cfg=j_cfg, t_cfg=t_cfg, st_j=st_j,
                st_t=st_t, w_j=w_j, w_t=w_t, wd=wd, zmin=zmin)


def _opt_vars(wd, zmin):
    """The warm start with some noise, lowered so that its lowest vertex
    is 5 cm into the floor (world z = camera y + 1.2 in the synthetic
    scene), so the SDF and friction terms fire."""
    rng = np.random.RandomState(5)
    ws = wd["warm_start"]
    ov = {k: (np.asarray(ws[k]) + rng.randn(*ws[k].shape) * 0.02
              ).astype(np.float32)
          for k in ("transl", "global_orient", "left_hand_pose",
                    "right_hand_pose", "jaw_pose", "leye_pose", "reye_pose",
                    "expression", "pose_embedding")}
    ov["transl"][:, 1] -= zmin + 0.05
    betas = np.broadcast_to(np.asarray(ws["betas"]).mean(0, keepdims=True),
                            ws["betas"].shape).astype(np.float32)
    return ov, betas


_FORMS = {
    "full": dict(depth_scan_cand_ids=None, depth_vert_cand_ids=None,
                 s2m_frozen=None, m2s_frozen=None, depth_vis_frozen=None),
    "candidates": {},
    "candidates_live_visibility": dict(depth_vis_frozen=None),
}


@pytest.mark.parametrize("form", list(_FORMS))
def test_every_term_and_gradient_matches_jax(window, form):
    w = window
    st_j = dataclasses.replace(w["st_j"], **_FORMS[form])
    st_t = dataclasses.replace(w["st_t"], **_FORMS[form])
    vpp = w["info"]["vposer_params"]
    mapper = smpl_to_openpose()
    j_loss = j_losses.make_prox_loss(j_fwd(w["jm"]), w["jm"].consts, mapper,
                                     vpp, st_j, w["w_j"])
    t_loss = t_losses.make_prox_loss(t_fwd(w["tm"]), w["tm"].consts, mapper,
                                     w["t_assets"].vposer_params, st_t,
                                     w["w_t"])
    ov, betas = _opt_vars(w["wd"], w["zmin"])
    jov = {k: jnp.asarray(v) for k, v in ov.items()}
    jb = jnp.asarray(betas)
    # term values on ONE forward output (the JAX one), so they compare
    # the loss terms alone: the two forwards differ by f32 noise
    # (~5e-7 m, as much as lemo_tpu's jitted and eager forwards differ),
    # which the smoothness prior's second differences amplify ~100x
    out_j = jax.jit(j_loss.forward_part)(jov, jb)
    _, jterms = jax.jit(j_loss.terms_part)(jov, jb, out_j, st_j)
    tov = {k: torch.tensor(v, requires_grad=True) for k, v in ov.items()}
    tb = torch.as_tensor(betas)
    out_t = {k: torch.tensor(np.asarray(v)) for k, v in out_j.items()}
    _, tterms = t_loss.terms_part(tov, tb, out_t, st_t)
    assert set(tterms) == set(jterms)
    for k in ("joint_loss", "s2m_dist", "m2s_dist", "sdf_penetration_loss",
              "loss_fric_tangent", "contact_loss",
              "motion_prior_smooth_loss", "motion_infill_loss"):
        assert float(jterms[k]) > 0, k
    for k, v in jterms.items():
        ref = float(v)
        got = float(tterms[k].detach())
        assert abs(got - ref) <= 1e-5 * abs(ref) + 1e-12, (k, got, ref)
    # gradients of the terms with respect to the parameters they read
    # and to the forward's outputs, on the same forward output (the
    # forward's own VJP is held to lemo_tpu's in test_torch_body_model)
    jg = jax.jit(jax.grad(lambda v, o: j_loss.terms_part(v, jb, o, st_j)[0],
                          argnums=(0, 1)))(jov, out_j)
    for v in out_t.values():
        v.requires_grad_(True)
    tt, _ = t_loss.terms_part(tov, tb, out_t, st_t)
    leaves = list(tov.values()) + list(out_t.values())
    tg = torch.autograd.grad(tt, leaves, allow_unused=True)
    refs = [jg[0][k] for k in tov] + [jg[1][k] for k in out_t]
    for name, g, ref in zip(list(tov) + list(out_t), tg, refs):
        ref = np.asarray(ref)
        g = np.zeros_like(ref) if g is None else g.numpy()
        scale = max(np.abs(ref).max(), 1e-12)
        err = np.abs(g - ref).max() / scale
        assert err <= 1e-4, (name, err)


def _jax_warm_vertices(w):
    """lemo_tpu's warm-start body, given to both packages' candidate
    pre-passes so that argsort ties are not reordered by the two
    forwards' f32 noise."""
    ws = {k: jnp.asarray(v) for k, v in w["wd"]["warm_start"].items()}
    return ws, np.asarray(j_driver._warm_start_vertices(
        w["j_cfg"], w["j_assets"], ws))


def test_depth_candidate_data_matches_jax(window):
    w = window
    ws, verts = _jax_warm_vertices(w)
    base_j = dataclasses.replace(w["st_j"], **_FORMS["full"])
    base_t = dataclasses.replace(w["st_t"], **_FORMS["full"])
    ref = j_driver._depth_candidate_data(w["j_cfg"], w["j_assets"], ws,
                                         base_j)
    out = t_driver._depth_candidate_data(w["t_cfg"], torch.as_tensor(verts),
                                         base_t)
    sids, vids, s2m_fr, m2s_fr, vis_c = out
    np.testing.assert_array_equal(sids, ref[0])
    np.testing.assert_array_equal(vids, ref[1])
    np.testing.assert_allclose(s2m_fr, ref[2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m2s_fr, ref[3], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(vis_c, ref[4])
    # the JAX window static used the same sets
    np.testing.assert_array_equal(sids, np.asarray(w["st_j"]
                                                   .depth_scan_cand_ids))


def test_sdf_candidate_ids_match_jax(window):
    w = window
    _, verts = _jax_warm_vertices(w)
    out = t_driver._sdf_candidate_ids(w["t_cfg"], torch.as_tensor(verts),
                                      w["st_t"])
    np.testing.assert_array_equal(out, np.asarray(
        w["st_j"].sdf_candidate_ids))


def test_coll_weight_raises_naming_the_slice(window):
    """The self-interpenetration term, which raised before its slice was
    ported, now matches lemo_tpu's on the window: its value on the same
    forward output within rel 3e-4 (the dense XLA sweep rounds the face
    geometry differently, so a few razor-edge gates may flip; the bound
    of tests/test_intersection_pallas.py), with and without the 27-part
    filter."""
    w = window
    faces = np.asarray(w["info"]["model_dict"]["f"])
    segm = faces.min(axis=1) * 27 // (int(faces.max()) + 1)
    tab = np.random.RandomState(7).rand(27, 27) < 0.2
    tab |= tab.T
    vpp = w["info"]["vposer_params"]
    ov, betas = _opt_vars(w["wd"], w["zmin"])
    jov = {k: jnp.asarray(v) for k, v in ov.items()}
    tov = {k: torch.as_tensor(v) for k, v in ov.items()}
    vals = []
    for parts in (False, True):
        extra = dict(faces=faces, faces_segm=segm if parts else None,
                     ign_table=tab if parts else None)
        st_j = dataclasses.replace(
            w["st_j"], **{k: None if v is None else jnp.asarray(v)
                          for k, v in extra.items()})
        st_t = prox_static_from_numpy(st_j, "cpu", sdf_mode="fp8")
        j_loss = j_losses.make_prox_loss(
            j_fwd(w["jm"]), w["jm"].consts, smpl_to_openpose(), vpp, st_j,
            dataclasses.replace(w["w_j"], coll=1e-5))
        t_loss = t_losses.make_prox_loss(
            t_fwd(w["tm"]), w["tm"].consts, smpl_to_openpose(),
            w["t_assets"].vposer_params, st_t,
            dataclasses.replace(w["w_t"], coll=1e-5))
        out_j = jax.jit(j_loss.forward_part)(jov, jnp.asarray(betas))
        _, jterms = jax.jit(j_loss.terms_part)(jov, jnp.asarray(betas),
                                               out_j, st_j)
        out_t = {k: torch.tensor(np.asarray(v)) for k, v in out_j.items()}
        _, tterms = t_loss.terms_part(tov, torch.as_tensor(betas), out_t,
                                      st_t)
        ref = float(jterms["self_penetration_loss"])
        got = float(tterms["self_penetration_loss"])
        assert ref > 0
        assert abs(got - ref) <= 3e-4 * ref, (parts, got, ref)
        vals.append(got)
    assert vals[1] < vals[0]
