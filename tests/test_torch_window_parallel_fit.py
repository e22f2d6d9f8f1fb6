"""The port's window-parallel fitter against `lemo_tpu`'s on the CPU.

- `make_batched_window_fitter` (impl='fold') on both packages' setups of
  W windows with the same statics and warm starts, at
  tests/test_window_parallel.py's tolerances (losses rtol 2e-3 / atol
  2e-5, parameters rtol 6e-2 / atol 2e-3, final terms rtol 5e-3 / atol
  1e-5): keypoints, SDF and friction on three windows; and every term
  with interpenetration and depth on, on two windows;
- both packages' batched candidate pre-pass picks one self-intersection
  K for windows whose own K differ, with equal candidate ids;
- the fold's first window against the port's sequential fitter, at
  lemo_tpu's fold-against-sequential tolerances, and a one-window fold
  equal to it bit for bit;
- the per-window NaN freeze: a NaN in one window's keypoints leaves the
  others bit-equal to the healthy run's;
- the sequential fitter runs whole chunks of `steps_per_dispatch` steps,
  as `lemo_tpu`'s does;
- the Jacobi polish's round counts.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.body_model.vertex_ids import smpl_to_openpose
from lemo_tpu.config import ProxConfig as JConfig
from lemo_tpu.data.prox import ProxRecording as JRec
from lemo_tpu.data.prox import ProxWindowDataset as JDataset
from lemo_tpu.data.stats import GlobalStats as JGlobal
from lemo_tpu.data.stats import Local4ChanStats as JLocal
from lemo_tpu.fitting.prox import driver as j_driver
from lemo_tpu.fitting.prox import window as j_window
from lemo_tpu.fitting.prox.infill_prepass import \
    InfillPrepassResult as JInfill
from lemo_tpu.fitting.prox.infill_prepass import \
    make_batched_prepass as j_prepass
from lemo_tpu.fitting.prox.losses import PER_WINDOW_FIELDS as J_PER_WINDOW
from lemo_tpu.priors.conv_ae import init_smooth_enc
from lemo_tpu.testing.synthetic import synthetic_smplx_npz as j_npz
from lemo_tpu.testing.synthetic_prox import \
    write_synthetic_prox_recording as j_write
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.config import ProxConfig as TConfig
from lemo_tpu_torch.convert import from_numpy_tree, prox_static_from_numpy
from lemo_tpu_torch.fitting.prox import driver as t_driver
from lemo_tpu_torch.fitting.prox import losses as t_losses
from lemo_tpu_torch.fitting.prox import window as t_window
from lemo_tpu_torch.testing.synthetic import write_part_segm_pkl

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "lemo_tpu", "assets")
MAPPER = smpl_to_openpose()


def _stack_j(statics):
    kw = {}
    for f in dataclasses.fields(statics[0].__class__):
        vals = [getattr(s, f.name) for s in statics]
        kw[f.name] = (jnp.stack(vals)
                      if f.name in J_PER_WINDOW and vals[0] is not None
                      else vals[0])
    return statics[0].__class__(**kw)


def _build(info, cfg, j_assets, t_assets, n_windows, sdf_mode,
           candidates=True):
    """Both packages' statics of the first `n_windows` windows (the JAX
    driver's, converted) and their warm starts; without their candidate
    sets unless `candidates`."""
    rec = JRec.from_recording_dir(cfg.recording_dir)
    ds = JDataset(rec, output_params_dir=tempfile.mkdtemp(),
                  batch_size=cfg.batch_size, flip=cfg.flip,
                  read_depth=cfg.read_depth and (cfg.s2m or cfg.m2s),
                  read_mask=cfg.read_mask, mask_on_color=cfg.mask_on_color)
    jw = ds.joint_weights()
    wds = [ds.load_window(i) for i in range(n_windows)]
    warm = {k: np.stack([np.asarray(wd["warm_start"][k]) for wd in wds])
            for k in wds[0]["warm_start"]}
    irs = [None] * n_windows
    if cfg.use_motion_infill_prior:
        wwm = j_driver._make_warm_world_markers(j_assets, rec)
        mv, mj = jax.vmap(wwm)({k: jnp.asarray(v) for k, v in warm.items()})
        masks = np.stack([wd["marker_mask"] for wd in wds])
        tw, cl = j_prepass(j_assets.infill_stats,
                           finetune_steps=cfg.infill_finetune_steps)(
            j_assets.infill_ae_params, mv, mj, jnp.asarray(masks))
        irs = [JInfill(tw[i], cl[i], True) for i in range(n_windows)]
    st_j = [j_driver.build_window_static(cfg, j_assets, rec, wd, jw, ir,
                                         with_candidates=False)
            for wd, ir in zip(wds, irs)]
    if candidates:
        st_j = j_driver._apply_candidates_batch(
            cfg, j_assets, [wd["warm_start"] for wd in wds], st_j)
    st_t = [prox_static_from_numpy(s, "cpu", sdf_mode=sdf_mode)
            for s in st_j]
    return st_j, st_t, warm


@pytest.fixture(scope="module")
def keypoints_sdf():
    """tests/test_window_parallel.py:115-188's setup."""
    info = j_write(tempfile.mkdtemp(), num_frames=40, seed=13,
                   write_depth=False)
    cfg = JConfig(
        recording_dir=info["recording_dir"],
        output_folder=tempfile.mkdtemp(), batch_size=16, maxiters=6,
        lr=0.005, flip=False, s2m=False, m2s=False, read_depth=False,
        read_mask=False, sdf_penetration=True, use_friction=True,
        use_motion_smooth_prior=False, interpenetration=False,
        contact=False, use_motion_infill_prior=False)
    jm = j_load(info["model_dict"], use_pca=True, num_pca_comps=12)
    tm = t_load(info["model_dict"], use_pca=True, num_pca_comps=12,
                device="cpu")
    vpp = {k: np.asarray(v) for k, v in info["vposer_params"].items()}
    j_assets = j_driver.ProxAssets(model=jm, vposer_params=vpp)
    t_assets = t_driver.ProxAssets(model=tm,
                                   vposer_params=from_numpy_tree(vpp, "cpu"))
    st_j, st_t, warm = _build(info, cfg, j_assets, t_assets, 3, "bf16")
    return dict(cfg=cfg, jm=jm, tm=tm, j_assets=j_assets, t_assets=t_assets,
                st_j=st_j, st_t=st_t, warm=warm)


@pytest.fixture(scope="module")
def all_terms():
    """tests/test_torch_prox_window.py's setup (17 frames, two windows of
    10, the all-terms Stage-3 config) with interpenetration on, on the
    smooth-surface body of tests/test_torch_coll.py with its 27-part
    segmentation (on the default body the cone energy's plain version
    fires on most faces and takes minutes on the CPU)."""
    md = j_npz(smooth_surface=True)
    info = j_write(tempfile.mkdtemp(), num_frames=17, seed=2,
                   occlusion_frac=0.3, model_dict=md, pose_scale=0.9)
    pkl = os.path.join(tempfile.mkdtemp(), "parts_segm.pkl")
    write_part_segm_pkl(pkl, md["f"], num_parts=27)
    rng = np.random.RandomState(1)
    smooth = JGlobal(Xmean=rng.randn(1, 1, 243) * 0.1,
                     Xstd=np.ones(243) * 0.05)
    enc = {k: np.asarray(v) for k, v in
           init_smooth_enc(jax.random.PRNGKey(0)).items()}
    ae = dict(np.load(os.path.join(ASSETS, "infill_ae.npz")))
    stats = JLocal.load(os.path.join(ASSETS, "infill_stats.npz"))
    vpp = {k: np.asarray(v) for k, v in info["vposer_params"].items()}
    jm = j_load(info["model_dict"], use_pca=True, num_pca_comps=12)
    tm = t_load(info["model_dict"], use_pca=True, num_pca_comps=12,
                device="cpu")
    from lemo_tpu.config import parse_config

    cfg = parse_config([
        "--config", os.path.join(REPO, "cfg_files",
                                 "PROXD_temp_S3_all_terms.yaml"),
        "--recording_dir", info["recording_dir"], "--output_folder",
        tempfile.mkdtemp(), "--batch_size", "10", "--maxiters", "5",
        "--flip", "false", "--depth_candidates", "64", "--sdf_candidates",
        "64", "--coll_candidates", "64", "--infill_finetune_steps", "2",
        "--part_segm_fn", pkl])
    assert cfg.interpenetration and cfg.s2m and cfg.m2s
    rec = JRec.from_recording_dir(info["recording_dir"])
    segm, tab = j_driver.load_part_segm(pkl, jm.faces, cfg.ign_part_pairs)
    j_assets = j_driver.ProxAssets(
        faces_segm=segm, ign_table=tab,
        model=jm, vposer_params={k: jnp.asarray(v) for k, v in vpp.items()},
        smooth_enc_params={k: jnp.asarray(v) for k, v in enc.items()},
        smooth_stats=smooth,
        infill_ae_params={k: jnp.asarray(v) for k, v in ae.items()},
        infill_stats=stats, scene_verts=rec.load_scene_mesh())
    t_assets = t_driver.ProxAssets(model=tm,
                                   vposer_params=from_numpy_tree(vpp, "cpu"))
    st_j, st_t, warm = _build(info, cfg, j_assets, t_assets, 2, "bf16")
    return dict(cfg=cfg, jm=jm, tm=tm, j_assets=j_assets, t_assets=t_assets,
                st_j=st_j, st_t=st_t, warm=warm)


def _fit_both(s, steps_per_dispatch=None, t_statics=None):
    cfg = s["cfg"]
    W = len(s["st_j"])
    first = np.arange(W) == 0
    spd = steps_per_dispatch or cfg.steps_per_dispatch
    weights = j_driver.weights_from_config(cfg)
    jf = j_window.make_batched_window_fitter(
        s["jm"], s["j_assets"].vposer_params, MAPPER, s["st_j"][0], weights,
        maxiters=cfg.maxiters, lr=cfg.lr, mesh=None, steps_per_dispatch=spd,
        impl="fold")
    ref = jf(_stack_j(s["st_j"]),
             {k: jnp.asarray(v) for k, v in s["warm"].items()},
             jnp.asarray(first))
    out = _fit_port(s, spd, t_statics)
    return ref, out


def _fit_port(s, spd, t_statics=None, warm=None):
    cfg = s["cfg"]
    statics = t_statics or s["st_t"]
    W = len(statics)
    tf = t_window.make_batched_window_fitter(
        s["tm"], s["t_assets"].vposer_params, MAPPER, statics[0],
        t_losses.ProxWeights(**dataclasses.asdict(
            j_driver.weights_from_config(cfg))),
        maxiters=cfg.maxiters, lr=cfg.lr, steps_per_dispatch=spd)
    return tf(t_losses.stack_statics(statics),
              {k: torch.as_tensor(v) for k, v in
               (warm or s["warm"]).items()}, np.arange(W) == 0)


def _compare(ref, out):
    ov_j, _, losses_j, terms_j = ref
    ov_t, _, losses_t, terms_t = out
    assert losses_t.shape == losses_j.shape
    np.testing.assert_allclose(losses_t.numpy(), losses_j, rtol=2e-3,
                               atol=2e-5)
    assert set(ov_t) == set(ov_j)
    for k in ov_j:
        np.testing.assert_allclose(ov_t[k].numpy(), np.asarray(ov_j[k]),
                                   rtol=6e-2, atol=2e-3, err_msg=k)
    assert set(terms_t) == set(terms_j)
    for k in terms_j:
        np.testing.assert_allclose(terms_t[k].numpy(), terms_j[k],
                                   rtol=5e-3, atol=1e-5, err_msg=k)


def test_fold_matches_jax_keypoints_sdf(keypoints_sdf):
    ref, out = _fit_both(keypoints_sdf)
    _compare(ref, out)
    assert out[2].shape == (3, 6)
    assert float(out[3]["sdf_penetration_loss"].max()) >= 0


def test_fold_matches_jax_all_terms(all_terms):
    """Every term with interpenetration and depth on, and whole chunks:
    5 iterations at 2 steps a chunk run 6 steps, and the history is not
    cut."""
    ref, out = _fit_both(all_terms, steps_per_dispatch=2)
    assert out[2].shape == (2, 6)
    _compare(ref, out)
    for k in ("self_penetration_loss", "s2m_dist", "m2s_dist",
              "contact_loss", "motion_infill_loss",
              "motion_prior_smooth_loss"):
        assert float(out[3][k].min()) > 0, k


def test_one_coll_K_matches_jax(all_terms):
    """Both packages' batched candidate pre-pass (`_apply_candidates_batch`)
    on the all-terms setup with interpenetration on, at a configured K
    that the first window's firing faces exceed and the other's do not,
    so that each window alone would get its own K: both pick one K for
    all windows from the largest counts, with equal self-intersection
    candidate ids and the port's per-window counts equal to lemo_tpu's
    broad phase's."""
    s = all_terms
    j_assets = s["j_assets"]
    warms = [{k: v[i] for k, v in s["warm"].items()} for i in range(2)]
    counts = [j_driver._coll_candidate_scores(s["cfg"], j_assets, w)[1]
              for w in warms]
    per_window = [(int(c[:, 0].max()), int(c[:, 1].max())) for c in counts]
    cfg = dataclasses.replace(
        s["cfg"], coll_candidates=min(na for na, _ in per_window))
    F = int(s["tm"].faces.shape[0])
    own = [j_driver._coll_pick_K(cfg, na, nw, F) for na, nw in per_window]
    assert own[0] != own[1], own
    st_j, st_t, _ = _build(None, cfg, j_assets, s["t_assets"], 2, "bf16",
                           candidates=False)
    ref = j_driver._apply_candidates_batch(cfg, j_assets, warms, st_j)
    t_assets = dataclasses.replace(
        s["t_assets"], faces_segm=np.asarray(j_assets.faces_segm),
        ign_table=np.asarray(j_assets.ign_table))
    got, broad = t_driver._apply_candidates_batch(
        TConfig(**dataclasses.asdict(cfg)), t_assets,
        {k: torch.as_tensor(v) for k, v in s["warm"].items()}, st_t)
    assert broad["per_window"] == per_window
    assert broad["K"] == max(own)
    for r, g in zip(ref, got):
        assert np.asarray(r.coll_candidate_ids).shape == \
            tuple(g.coll_candidate_ids.shape) == (10, broad["K"])
        np.testing.assert_array_equal(g.coll_candidate_ids.numpy(),
                                      np.asarray(r.coll_candidate_ids))


def test_fold_window_matches_the_sequential_fitter(keypoints_sdf):
    """The first window of the fold against the port's sequential fitter
    on its static, 6 steps:
    transl within atol 2e-5 and the losses within rtol 2e-4 (lemo_tpu's
    fold-against-sequential tolerances, tests/test_window_parallel.py:
    42-45)."""
    s = keypoints_sdf
    cfg = s["cfg"]
    ov, _, losses, _ = _fit_port(s, 100)
    seq = t_window.make_window_fitter(
        s["tm"], s["t_assets"].vposer_params, MAPPER, s["st_t"][0],
        t_losses.ProxWeights(**dataclasses.asdict(
            j_driver.weights_from_config(cfg))),
        maxiters=cfg.maxiters, lr=cfg.lr)
    final, l_seq, _, _ = seq(s["st_t"][0],
                             {k: torch.as_tensor(v[0])
                              for k, v in s["warm"].items()}, True)
    np.testing.assert_allclose(ov["transl"][0].numpy(),
                               final["transl"].numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(losses[0].numpy(), l_seq.numpy(), rtol=2e-4)


def test_one_window_fold_is_the_sequential_fit(keypoints_sdf):
    """A fold of one window runs the sequential fit's frame batch, so it
    gives the sequential fitter's parameters and losses bit for bit."""
    s = keypoints_sdf
    cfg = s["cfg"]
    warm1 = {k: v[:1] for k, v in s["warm"].items()}
    ov, _, losses, _ = _fit_port(s, 100, t_statics=s["st_t"][:1],
                                 warm=warm1)
    seq = t_window.make_window_fitter(
        s["tm"], s["t_assets"].vposer_params, MAPPER, s["st_t"][0],
        t_losses.ProxWeights(**dataclasses.asdict(
            j_driver.weights_from_config(cfg))),
        maxiters=cfg.maxiters, lr=cfg.lr)
    final, l_seq, _, _ = seq(s["st_t"][0], {k: torch.as_tensor(v[0])
                                            for k, v in warm1.items()}, True)
    for k in final:
        assert torch.equal(ov[k][0], final[k]), k
    assert torch.equal(losses[0], l_seq)


def test_nan_window_freezes_alone(keypoints_sdf):
    s = keypoints_sdf
    sick = list(s["st_t"])
    gt = sick[1].gt_joints.clone()
    gt[3, 5, 0] = float("nan")
    sick[1] = dataclasses.replace(sick[1], gt_joints=gt)
    ov_h, _, l_h, _ = _fit_port(s, 100)
    ov_s, _, l_s, _ = _fit_port(s, 100, t_statics=sick)
    assert bool(torch.isnan(l_s[1]).all())
    for i in (0, 2):
        assert torch.equal(l_s[i], l_h[i])
        for k in ov_h:
            assert torch.equal(ov_s[k][i], ov_h[k][i]), (i, k)
    for k in ov_s:
        assert torch.equal(ov_s[k][1], torch.as_tensor(s["warm"][k][1])), k


def test_sequential_fitter_runs_whole_chunks(keypoints_sdf):
    """maxiters 3 at steps_per_dispatch 2: lemo_tpu steps 4 times and
    cuts the histories to 3; so does the port. A fit of exactly 3 steps
    ends elsewhere, beyond the comparison's tolerance."""
    s = keypoints_sdf
    cfg = s["cfg"]
    weights = j_driver.weights_from_config(cfg)
    t_w = t_losses.ProxWeights(**dataclasses.asdict(weights))
    jf = j_window.make_window_fitter(
        s["jm"], s["j_assets"].vposer_params, MAPPER, s["st_j"][0], weights,
        maxiters=3, lr=cfg.lr, steps_per_dispatch=2)
    warm0 = {k: v[0] for k, v in s["warm"].items()}
    ov_j, l_j, terms_j, _ = jf(s["st_j"][0],
                               {k: jnp.asarray(v) for k, v in warm0.items()},
                               True)
    warm_t = {k: torch.as_tensor(v) for k, v in warm0.items()}
    outs = {}
    for spd in (2, 3):
        tf = t_window.make_window_fitter(
            s["tm"], s["t_assets"].vposer_params, MAPPER, s["st_t"][0], t_w,
            maxiters=3, lr=cfg.lr, steps_per_dispatch=spd)
        outs[spd] = tf(s["st_t"][0], warm_t, True)
    ov_t, l_t, terms_t, _ = outs[2]
    assert l_t.shape == (3,) == np.asarray(l_j).shape
    assert terms_t["total_loss"].shape == (3,)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=2e-3,
                               atol=2e-5)
    got = ov_t["transl"].numpy()
    ref = np.asarray(ov_j["transl"])
    assert np.abs(got - ref).max() <= 1e-4
    assert np.abs(outs[3][0]["transl"].numpy() - ref).max() > 1e-3


@pytest.mark.parametrize("polish,rounds,chunk,want", [
    (250, 3, 100, (2, 125, 200)),     # the overshoot: 2 rounds of 200
    (100, 3, 100, (1, 100, 100)),
    (300, 3, 100, (3, 100, 100)),
    (50, 3, 100, (1, 50, 100)),
    (900, 3, 450, (2, 450, 450)),
    (30, 3, 6, (3, 10, 12)),
    (10, 3, 4, (2, 5, 8)),
])
def test_jacobi_round_counts(polish, rounds, chunk, want):
    """(rounds, iterations a round, steps a round run in whole chunks), as
    lemo_tpu/fitting/prox/driver.py:976-979 and window.py:449-459 count
    them."""
    n, iters = t_driver.jacobi_rounds(polish, rounds, chunk)
    assert (n, iters, t_window.whole_chunks(iters, chunk)) == want
