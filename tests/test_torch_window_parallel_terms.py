"""The window-parallel loss of the port on the CPU: `terms_folded` on
W = 3 windows folded into one frame batch against a loop of the
sequential `terms_part` over the windows, every term within rel 1e-5 and
the parameter gradients within rel 1e-4 of each gradient's scale, with
every loss family on (self-intersection on auto-grown candidates, depth
and SDF candidates, contact, friction, the smoothness prior and the
infill terms); the batched candidate pre-pass against the per-window one;
and the per-window SDF crop against one `sample_sdf_world` call a
window."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from lemo_tpu_torch.body_model import load_model, make_forward_fn
from lemo_tpu_torch.body_model.vertex_ids import smpl_to_openpose
from lemo_tpu_torch.config.prox_config import ProxConfig
from lemo_tpu_torch.data.prox import ProxRecording, ProxWindowDataset
from lemo_tpu_torch.data.stats import GlobalStats, Local4ChanStats
from lemo_tpu_torch.fitting.prox import driver
from lemo_tpu_torch.fitting.prox import losses
from lemo_tpu_torch.fitting.prox.window import _OPT_KEYS
from lemo_tpu_torch.fitting.prox.infill_prepass import \
    make_batched_prepass, run_infill_prepass
from lemo_tpu_torch.ops.sdf import sample_sdf_windows, sample_sdf_world
from lemo_tpu_torch.priors.conv_ae import init_smooth_enc, \
    load_state_dict_npz
from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz, \
    write_part_segm_pkl
from lemo_tpu_torch.testing.synthetic_prox import \
    write_synthetic_prox_recording

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "lemo_tpu_torch", "assets")
T = 10
W = 3


@pytest.fixture(scope="module")
def windows():
    """Three windows of a 24-frame recording of the smooth-surface body,
    with every loss family's static built by the port's driver."""
    md = synthetic_smplx_npz(smooth_surface=True)
    info = write_synthetic_prox_recording(
        tempfile.mkdtemp(), num_frames=T + 2 * int(T * 0.7),
        model_dict=md, seed=4, occlusion_frac=0.3, pose_scale=0.9)
    pkl = os.path.join(tempfile.mkdtemp(), "parts_segm.pkl")
    write_part_segm_pkl(pkl, md["f"], num_parts=27)
    cfg = ProxConfig(
        recording_dir=info["recording_dir"], batch_size=T, flip=False,
        s2m=True, m2s=True, contact=True, interpenetration=True,
        coll_loss_weights=[1.0], coll_candidates=8,
        coll_candidates_auto=True, part_segm_fn=pkl,
        ign_part_pairs=["9,16", "9,17", "6,16", "6,17", "1,2", "12,22"],
        use_motion_infill_prior=True, sdf_candidates=48,
        depth_candidates=40, infill_finetune_steps=2,
        friction_normal_weights=[1.0], friction_tangent_weights=[1.0])
    model = load_model(md, use_pca=True, num_pca_comps=12, device="cpu")
    segm, tab = driver.part_filter(cfg, model.faces)
    rng = np.random.RandomState(1)
    assets = driver.ProxAssets(
        model=model, vposer_params=info["vposer_params"],
        smooth_enc_params=init_smooth_enc(torch.Generator().manual_seed(0)),
        smooth_stats=GlobalStats.from_numpy(rng.randn(1, 1, 243) * 0.1,
                                            np.ones(243) * 0.01, "cpu"),
        infill_ae_params=load_state_dict_npz(
            os.path.join(ASSETS, "infill_ae.npz"), "cpu"),
        infill_stats=Local4ChanStats.load(
            os.path.join(ASSETS, "infill_stats.npz"), "cpu"),
        faces_segm=segm, ign_table=tab)
    rec = ProxRecording.from_recording_dir(info["recording_dir"])
    assets = dataclasses.replace(assets, scene_verts=rec.load_scene_mesh())
    ds = ProxWindowDataset(rec, output_params_dir=tempfile.mkdtemp(),
                           batch_size=T, flip=False)
    assert len(ds.windows) == W
    wds = [ds.load_window(i) for i in range(W)]
    jw = ds.joint_weights()
    warm = {k: torch.as_tensor(np.stack([wd["warm_start"][k] for wd in wds]))
            for k in wds[0]["warm_start"]}
    flat = {k: v.reshape((W * T,) + v.shape[2:]) for k, v in warm.items()}
    mv, mj = driver._make_warm_world_markers(assets, rec)(flat)
    masks = torch.as_tensor(np.stack([wd["marker_mask"] for wd in wds]))
    tw, cl = make_batched_prepass(assets.infill_stats, finetune_steps=2)(
        assets.infill_ae_params, mv.reshape(W, T, 67, 3),
        mj.reshape(W, T, 25, 3), masks)
    irs = [driver.InfillPrepassResult(tw[i], cl[i], True) for i in range(W)]
    statics = [driver.build_window_static(cfg, assets, rec, wd, jw, ir,
                                          with_candidates=False)[0]
               for wd, ir in zip(wds, irs)]
    statics, broad = driver._apply_candidates_batch(cfg, assets, warm,
                                                    statics)
    return dict(cfg=cfg, assets=assets, rec=rec, wds=wds, jw=jw, warm=warm,
                statics=statics, broad=broad, mv=mv, mj=mj, masks=masks,
                tw=tw, cl=cl)


def test_batched_prepass_is_a_loop_of_the_window_prepass(windows):
    w = windows
    a = w["assets"]
    for i in (0, 2):
        ref = run_infill_prepass(a.infill_ae_params,
                                 w["mv"].reshape(W, T, 67, 3)[i],
                                 w["mj"].reshape(W, T, 25, 3)[i],
                                 w["masks"][i], a.infill_stats,
                                 finetune_steps=2)
        assert torch.equal(ref.targets_world, w["tw"][i])
        assert torch.equal(ref.contact_lbl, w["cl"][i])


def test_batched_candidates_match_the_window_prepass(windows):
    """One coll K for all windows, the largest window's auto-K; every
    window's SDF, depth and coll sets equal its own pre-pass's (the coll
    set at the shared K)."""
    w = windows
    cfg, assets = w["cfg"], w["assets"]
    bp = w["broad"]
    Ks = [driver._coll_pick_K(cfg, na, nw, assets.model.faces.shape[0])
          for na, nw in bp["per_window"]]
    assert bp["K"] == max(Ks) > cfg.coll_candidates
    assert (bp["n_active"], bp["n_within"]) == tuple(
        max(c[j] for c in bp["per_window"]) for j in range(2))
    for i, st in enumerate(w["statics"]):
        warm = {k: v[i] for k, v in w["warm"].items()}
        base = dataclasses.replace(
            st, coll_candidate_ids=None, sdf_candidate_ids=None,
            depth_scan_cand_ids=None, depth_vert_cand_ids=None,
            s2m_frozen=None, m2s_frozen=None, depth_vis_frozen=None)
        upd = driver._candidate_updates(
            dataclasses.replace(cfg, coll_candidates=bp["K"]), assets, warm,
            base)
        assert upd["broad_phase"]["K"] == bp["K"]
        for name in ("coll_candidate_ids", "sdf_candidate_ids",
                     "depth_scan_cand_ids", "depth_vert_cand_ids",
                     "depth_vis_frozen"):
            assert torch.equal(getattr(st, name), upd[name]), name
        for name in ("s2m_frozen", "m2s_frozen"):
            torch.testing.assert_close(getattr(st, name), upd[name],
                                       rtol=1e-5, atol=1e-6)


def _opt_vars(cfg, assets, warm):
    """The warm starts with some noise, each window lowered so that its
    lowest vertex is 5 cm into the floor (world z = camera y + 1.2 in the
    synthetic scene), so the SDF and friction terms fire."""
    rng = np.random.RandomState(5)
    ov = {k: warm[k] + torch.as_tensor(
        rng.randn(*warm[k].shape).astype(np.float32) * 0.02)
        for k in _OPT_KEYS + ("pose_embedding",)}
    flat = {k: v.reshape((W * T,) + v.shape[2:]) for k, v in warm.items()}
    verts = driver._warm_start_vertices(cfg, assets, flat)
    zmin = (verts[..., 1] + 1.2).reshape(W, -1).min(1).values
    ov["transl"][..., 1] -= (zmin + 0.05)[:, None]
    betas = warm["betas"].mean(1, keepdim=True).expand_as(warm["betas"])
    return ov, betas.contiguous()


def test_folded_terms_equal_a_loop_of_window_terms(windows):
    w = windows
    cfg, assets = w["cfg"], w["assets"]
    model = assets.model
    loss_fn = losses.make_prox_loss(
        make_forward_fn(model), model.consts, smpl_to_openpose(),
        assets.vposer_params, w["statics"][0],
        driver.weights_from_config(cfg))
    ov, betas = _opt_vars(cfg, assets, w["warm"])
    ov = {k: v.requires_grad_(True) for k, v in ov.items()}
    st_b = losses.stack_statics(w["statics"])
    out = loss_fn.forward_part(
        {k: v.reshape((W * T,) + v.shape[2:]) for k, v in ov.items()},
        betas.reshape(W * T, -1))
    out_w = {k: v.reshape((W, T) + v.shape[1:]) for k, v in out.items()}
    totals, terms = loss_fn.terms_folded(ov, betas, out_w, st_b)
    assert totals.shape == (W,)
    g_fold = torch.autograd.grad(totals.sum(), list(ov.values()),
                                 retain_graph=True)
    loop_total = 0.0
    for i in range(W):
        # the window's sequential terms on the fold's own forward output,
        # so that only the per-window reductions differ
        total_i, terms_i = loss_fn.terms_part(
            {k: v[i] for k, v in ov.items()}, betas[i],
            {k: v[i] for k, v in out_w.items()}, w["statics"][i])
        assert set(terms_i) == set(terms)
        for k, v in terms_i.items():
            ref, got = float(v.detach()), float(terms[k][i].detach())
            assert abs(got - ref) <= 1e-5 * abs(ref) + 1e-12, (i, k, got, ref)
        loop_total = loop_total + total_i
    g_loop = torch.autograd.grad(loop_total, list(ov.values()))
    for name, g, ref in zip(ov, g_fold, g_loop):
        for i in range(W):
            scale = max(float(ref[i].abs().max()), 1e-12)
            err = float((g[i] - ref[i]).abs().max()) / scale
            assert err <= 1e-4, (i, name, err)
    # every family fires somewhere
    for k in ("joint_loss", "self_penetration_loss", "s2m_dist", "m2s_dist",
              "sdf_penetration_loss", "loss_fric_tangent", "contact_loss",
              "motion_prior_smooth_loss", "motion_infill_loss"):
        assert float(terms[k].max()) > 0, k


def test_fold_frames_and_stack_statics(windows):
    st_b = losses.stack_statics(windows["statics"])
    st0 = windows["statics"][0]
    for name in losses.PER_WINDOW_FIELDS:
        v = getattr(st_b, name)
        if v is not None:
            assert v.shape == (W,) + getattr(st0, name).shape, name
    assert st_b.faces is st0.faces and st_b.R is st0.R
    st_f = losses.fold_frames(st_b, W * T)
    assert st_f.coll_candidate_ids.shape[0] == W * T
    assert st_f.scan.shape[:1] == (W * T,)
    assert st_f.infill_targets.shape[0] == W
    assert st_f.sdf_candidate_ids.shape[0] == W


@pytest.mark.parametrize("mode", ["f32", "bf16", "fp8"])
def test_sdf_crop_is_per_window(mode):
    """On a grid larger than the crop, each window is cropped at its own
    bounding box: the batched sample equals one call a window bit for bit,
    where one crop over all windows would clamp the far ones."""
    from lemo_tpu_torch.ops.sdf import quantize_grid

    D = 136
    rng = np.random.RandomState(0)
    grid = torch.as_tensor(rng.randn(D, D, D).astype(np.float32))
    grid = grid if mode == "f32" else quantize_grid(grid, mode)
    gmin = torch.tensor([-3.0, -3.0, -1.0])
    gmax = torch.tensor([3.0, 3.0, 5.0])
    centres = np.array([[-2.8, -2.8, -0.8], [0.0, 0.5, 2.0],
                        [2.8, 2.8, 4.8]], np.float32)
    pts = torch.as_tensor(centres[:, None, None]
                          + rng.randn(3, 4, 50, 3).astype(np.float32) * 0.05)
    got = sample_sdf_windows(grid, pts, gmin, gmax, mode=mode)
    for i in range(3):
        assert torch.equal(got[i], sample_sdf_world(grid, pts[i], gmin, gmax,
                                                    mode=mode))
    whole = sample_sdf_world(grid, pts.reshape(-1, 3), gmin, gmax,
                             mode=mode).reshape(3, 4, 50)
    assert not torch.equal(whole, got)
